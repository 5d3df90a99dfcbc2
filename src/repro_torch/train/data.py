"""Deterministic synthetic data pipeline.

Generates reproducible token streams (seeded per step, host-sliceable for
multi-process data loading) with enough structure that the loss actually
falls: a k-gram Markov chain over the vocabulary, so next-token prediction
is learnable.  The stream is drawn with NumPy, so the same seed gives the
same tokens as the reference package's ``SyntheticDataset``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.backend import resolve_device


@dataclasses.dataclass
class SyntheticDataset:
    """Markov-chain token stream; next token = f(prev token) + noise."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # deterministic successor table: makes sequences predictable
        self._succ = rng.permutation(self.vocab)

    def batch(self, step: int) -> dict:
        """``tokens`` and ``labels``, (B, S) int32 tensors on the host."""
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}


def _frontend_shapes(cfg: ModelConfig, batch_size: int,
                     seq_len: int | None) -> dict:
    """Name -> shape of the frontend stubs an arch's batch carries."""
    out = {}
    if cfg.family == "vlm":
        out["vision_embed"] = (batch_size, cfg.n_vision_tokens, cfg.d_model)
    if cfg.family == "encdec":
        # speech frames scale with the text length when not pinned
        src = cfg.n_audio_frames or seq_len or 512
        out["enc_embed"] = (batch_size, src, cfg.d_model)
    return out


def extra_inputs(cfg: ModelConfig, batch_size: int,
                 dtype: torch.dtype = torch.float32,
                 seq_len: int | None = None, device="cuda") -> dict:
    """Modality-frontend STUBS (assignment): precomputed patch / frame
    embeddings for [vlm] / [audio] archs, zeros on ``device``."""
    return {k: torch.zeros(shp, dtype=dtype, device=resolve_device(device))
            for k, shp in _frontend_shapes(cfg, batch_size, seq_len).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stand-ins for one (arch x shape) dry-run cell's batch, tensors on
    the ``meta`` device (no storage): ``tokens`` (B, S) int32, ``labels``
    for a train cell, and the frontend stubs of :func:`extra_inputs` in
    ``dtype`` (decode cells add caches: ``serve.kvcache.abstract_cache``)."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=meta)}
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=meta)
    batch.update({k: torch.empty(shp, dtype=dtype, device=meta)
                  for k, shp in _frontend_shapes(cfg, B, S).items()})
    return batch
