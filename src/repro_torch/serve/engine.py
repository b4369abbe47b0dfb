"""Batched LM serving engine: ragged-prompt prefill + token-by-token
decode (the port's counterpart of the JAX package's ``serve/engine.py``).

As in the reference, this serves the auxiliary language models, not the
video pipeline.  Prompts are right-padded to a common length L; per-row
true lengths drive (a) the first token, taken from each row's last REAL
position, and (b) for the attention families the ``kv_len = pos + 1``
masking of every decode step, so padding never leaks into attention
(causal prefill never reads it, and decode overwrites it before
reading).  ``extras`` (the vlm family's ``patch_embeds``, the encdec
family's ``audio_embeds``) go into the prefill's batch beside the
tokens.  For the encdec family the self-attention cache is written at
``max_len`` and the cross cache holds the encoder's frames, which every
decode step reads whole (the reference pads ``cache["self"]`` only).
``max_new_tokens`` decode steps follow, each appending the token sampled
by the one before.

The ssm family (Mamba2) keeps the reference's semantics: a row shorter
than L runs its SSM state and conv tail over the padding too (the state
ABSORBS the right padding, ``repro/serve/engine.py``'s documented
limitation), so only the longest rows are served as they would be
alone; decode does not read ``pos``, and its state has no length, so
``max_len`` does not bound it.  The hybrid family (Zamba2) has both: its
SSM layers absorb the padding as the ssm family's, its shared attention
blocks mask by ``kv_len`` and keep a KV cache that ``max_len`` bounds.

Differences from the reference, all deliberate:
  * for a KV cache, ``max(lens) + max_new_tokens > max_len`` raises
    ValueError (the reference's out-of-range ``.at[].set`` drops the
    write silently), as do an empty prompt and a token id outside the
    vocabulary (JAX clamps the gather; on the card it would be a
    device-side fault);
  * for the encdec family, ``max(lens) + max_new_tokens`` past the
    decoder's position table (``encdec.MAX_DEC_POS`` rows) raises
    ValueError (JAX clamps the gather);
  * for the vlm family, a longest prompt not longer than the patch
    embeddings raises ValueError (``transformer.merge_patches``; the
    reference's concat changes the sequence length);
  * for the ssm and hybrid families, a batch whose longest prompt is
    shorter than d_conv - 1 tokens raises ValueError naming that limit
    (the reference's conv tail is then shorter than its cache, and its
    first decode step fails on the shape);
  * the prefill writes its cache at ``max_len`` at once (the reference
    pads it after) and computes logits only at each row's last real
    position (the same numbers);
  * the cache is updated in place, and the sampled tokens stay on the
    device until the end;
  * sampling at ``temperature > 0`` draws from a ``torch.Generator``
    seeded by (seed, step): deterministic given the seed, but not JAX's
    bits.  Greedy (``temperature == 0``) takes the first index of the
    maximum, as ``jnp.argmax``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import name_seed
from repro_torch.models.encdec import MAX_DEC_POS
from repro_torch.models.model import Model
from repro_torch.models.transformer import LMWeights


@dataclass
class ServeEngine:
    model: Model
    params: LMWeights
    max_len: int
    temperature: float = 0.0
    seed: int = 0

    def _sample(self, logits: torch.Tensor, key: str) -> torch.Tensor:
        """logits (B, V) f32 -> (B, 1) int32."""
        if self.temperature > 0:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(name_seed(key, self.seed))
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32)[:, None]

    def generate(self, prompts: List[List[int]], max_new_tokens: int,
                 extras: Optional[Dict[str, Any]] = None
                 ) -> List[List[int]]:
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        vocab = self.model.cfg.vocab_size
        if B == 0 or lens.min() == 0 or any(
                not 0 <= t < vocab for p in prompts for t in p):
            raise ValueError(f"prompts must be non-empty lists of token "
                             f"ids in [0, {vocab})")
        L = int(lens.max())
        if self.model.cache_has_length and L + max_new_tokens > self.max_len:
            raise ValueError(
                f"longest prompt {L} + max_new_tokens {max_new_tokens} > "
                f"max_len {self.max_len}: the cache has no room")
        if self.model.cfg.family == "encdec" \
                and L + max_new_tokens > MAX_DEC_POS:
            raise ValueError(
                f"longest prompt {L} + max_new_tokens {max_new_tokens} > "
                f"{MAX_DEC_POS}: the decoder's position table has no row")
        toks = np.zeros((B, L), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        dev = self.params.device
        logits, _, cache = self.model.forward(
            self.params, {"tokens": toks, **(extras or {})},
            return_cache=True, cache_len=self.max_len, logits_at=lens - 1)
        tok = self._sample(logits, "prefill")
        pos = torch.as_tensor(lens, device=dev)
        sampled = []
        for step in range(max_new_tokens):
            sampled.append(tok)
            logits, cache = self.model.decode_step(self.params, tok, pos,
                                                   cache)
            tok = self._sample(logits, f"step/{step}")
            pos = pos + 1
        out = [list(p) for p in prompts]
        if sampled:
            new = torch.cat(sampled, dim=1).cpu().tolist()
            for i in range(B):
                out[i].extend(new[i])
        return out
