"""Deterministic synthetic token pipeline.

Counterpart of ``repro.data.synthetic``: batch ``i`` is a pure function
of (seed, step), generated on the host by the reference's numpy code, bit
for bit, and handed over as tensors on the pipeline's device (the card
when None): int32 tokens and labels, and for the enc-dec family float32
source frame embeddings (``SyntheticEncDec``). A zipfian unigram marginal
plus a short-range Markov blend give non-trivial statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["SyntheticLM", "SyntheticEncDec", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    device: Any = None

    def _probs(self) -> np.ndarray:
        p = 1.0 / np.arange(1, self.vocab + 1) ** self.zipf_a
        return (p / p.sum()).astype(np.float32)

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """Tokens + next-token labels for one step: generated on the host,
        returned as int32 tensors on the pipeline's device."""
        dev = resolve_device(self.device, what="SyntheticLM.batch")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        probs = self._probs()
        b, s = self.global_batch, self.seq_len
        base = rng.choice(self.vocab, size=(b, s + 1), p=probs)
        # short-range structure: with prob .5 repeat the previous token + 1
        rep = rng.random((b, s + 1)) < 0.5
        for j in range(1, s + 1):
            base[:, j] = np.where(rep[:, j],
                                  (base[:, j - 1] + 1) % self.vocab,
                                  base[:, j])
        return {"tokens": torch.from_numpy(base[:, :-1].astype(np.int32)
                                           ).to(dev),
                "labels": torch.from_numpy(base[:, 1:].astype(np.int32)
                                           ).to(dev)}


@dataclasses.dataclass(frozen=True)
class SyntheticEncDec(SyntheticLM):
    """``SyntheticLM``'s tokens and labels plus ``src_embeds``
    ``(global_batch, src_len, d_model)`` float32, standard normal draws
    from ``SeedSequence([seed, step, 1])``."""

    d_model: int = 1024
    src_len: int = 256

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        out = super().batch(step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 1]))
        src = rng.normal(0, 1, (self.global_batch, self.src_len,
                                self.d_model)).astype(np.float32)
        out["src_embeds"] = torch.from_numpy(src).to(
            resolve_device(self.device, what="SyntheticEncDec.batch"))
        return out


def make_pipeline(cfg, seq_len: int, global_batch: int, seed: int = 0, *,
                  device=None) -> SyntheticLM:
    if cfg.family == "encdec":
        return SyntheticEncDec(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=global_batch, seed=seed,
                               device=device, d_model=cfg.d_model,
                               src_len=min(seq_len, 256))
    return SyntheticLM(vocab=cfg.vocab, seq_len=seq_len,
                       global_batch=global_batch, seed=seed, device=device)
