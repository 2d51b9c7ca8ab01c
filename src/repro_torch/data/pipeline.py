"""Deterministic synthetic data pipeline of the port, stateless-resumable by
step: a copy of ``repro.data.pipeline`` (numpy only), so that both packages
train on the same batches.

``batch_at(step)`` is a pure function of (seed, step) -- a restarted or
elastically-rescaled job regenerates exactly the batch it would have seen,
with no iterator state to checkpoint.  Token streams come from a counter-
mode PRNG (philox via numpy) with a Zipf-ish marginal so the loss curve is
non-trivial; modality extras (frames/patches) are Gaussian embeddings.

The token walk multiplies in int32, as the reference does: once vocab**2
passes 2**31 the product wraps (at vocab 128256 a token of 128000 is
followed by 55375, where exact arithmetic gives 102991).  The wrap is kept:
a walk in int64 would feed the port other batches than JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames_dim: Optional[int] = None     # whisper: frame-embedding dim
    n_frames: int = 0
    img_dim: Optional[int] = None        # vlm: patch-embedding dim
    n_patches: int = 0


class SyntheticLM:
    """Synthetic next-token-predictable streams.

    Each sequence is a noisy linear-congruential token walk: token_{t+1}
    depends deterministically on token_t 80% of the time, so a real model
    can actually reduce loss -- useful for the e2e training example."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        B, S = cfg.global_batch, cfg.seq_len
        start = rng.integers(0, cfg.vocab, size=(B,))
        noise = rng.random(size=(B, S + 1))
        jump = rng.integers(0, cfg.vocab, size=(B, S + 1))
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = start
        a, c = 6364136223846793005 % cfg.vocab, 1442695040888963407 % cfg.vocab
        for t in range(1, S + 1):
            follow = (toks[:, t - 1] * a + c) % cfg.vocab
            toks[:, t] = np.where(noise[:, t] < 0.8, follow, jump[:, t])
        out = {"tokens": toks.astype(np.int32)}
        if cfg.frames_dim:
            out["frames"] = rng.standard_normal(
                (B, cfg.n_frames, cfg.frames_dim), dtype=np.float32)
        if cfg.img_dim:
            out["img_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.img_dim), dtype=np.float32)
        return out

    def shard_for_host(self, batch, host_index: int, num_hosts: int):
        """Per-host slice of the global batch (multi-host feeding)."""
        return {
            k: v[host_index * v.shape[0] // num_hosts:
                 (host_index + 1) * v.shape[0] // num_hosts]
            for k, v in batch.items()
        }
