"""Deterministic, seekable synthetic LM data (numpy).

Counterpart of ``repro/data/synthetic.py``, host side only.  The batch for
step ``t`` is a pure function of ``(seed, t)``, and its tokens equal the
reference's for the same seed and shape.  The token stream is a
Zipf-distributed unigram draw mixed with a first-order Markov "phrase"
structure; labels are next-token targets with the final position masked.
The stub frontends' inputs (whisper's frame embeddings, the VLM's patch
embeddings) are drawn after the tokens from the same generator, so they too
equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["SyntheticLM"]


@dataclass(frozen=True)
class SyntheticLM:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    zipf_a: float = 1.2
    markov_p: float = 0.7        # P(next = f(prev)) vs fresh unigram draw

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step & 0x7FFFFFFF])
        )

    def batch(self, step: int) -> dict:
        """Numpy batch for one step: {'tokens','labels'[, stub embeddings]}."""
        b, s = self.shape.global_batch, self.shape.seq_len
        v = self.cfg.vocab
        rng = self._rng(step)

        # Zipf unigram (clipped to vocab) + deterministic "phrase" transitions.
        uni = np.minimum(rng.zipf(self.zipf_a, size=(b, s)), v - 1)
        chain = (uni * 2654435761 + 12345) % v     # cheap deterministic f(prev)
        use_chain = rng.random((b, s)) < self.markov_p
        tokens = uni.copy()
        tokens[:, 1:] = np.where(
            use_chain[:, 1:], chain[:, :-1], uni[:, 1:]
        )
        tokens = tokens.astype(np.int32)

        labels = np.full((b, s), -1, dtype=np.int32)
        labels[:, :-1] = tokens[:, 1:]
        out = {"tokens": tokens, "labels": labels}
        d = self.cfg.d_model
        if self.cfg.encoder is not None:
            out["enc_embeds"] = rng.standard_normal(
                (b, self.cfg.encoder.n_ctx, d)
            ).astype(np.float32) * 0.02
        if self.cfg.n_img_tokens:
            out["img_embeds"] = rng.standard_normal(
                (b, self.cfg.n_img_tokens, d)
            ).astype(np.float32) * 0.02
        return out
