"""The assigned input-shape cells (the port's copy of the JAX package's
``configs/shapes.py``).

Every LM-family arch is paired with the same four shapes.  ``train_*``
runs ``train.TrainStep``; ``prefill_*`` the prefill; ``decode_*`` /
``long_*`` the single-token decode step with a KV cache (or SSM state)
of ``seq_len``.

``long_500k`` requires sub-quadratic attention: it runs only for SSM/hybrid
archs and is recorded as a SKIP (with reason) for pure full-attention archs.
The reasons are the reference's strings, word for word.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

SHAPES = {s.name: s for s in ALL_SHAPES}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a human-readable reason if (arch, shape) must be skipped,
    else None.  Skips are part of the assignment, not failures."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k needs sub-quadratic attention; "
                f"{cfg.name} is a pure full-attention arch (see DESIGN.md)")
    return None


def cells_for(cfg: ModelConfig) -> List[Tuple[ShapeConfig, Optional[str]]]:
    """All four cells with their skip reason (None = runnable)."""
    return [(s, shape_skip_reason(cfg, s)) for s in ALL_SHAPES]
