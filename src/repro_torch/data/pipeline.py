"""Deterministic synthetic token pipeline (port of
``repro/data/pipeline.py``).

An infinite, seekable stream of fixed-length sequences: step -> batch is a
pure numpy function of (seed, step), so the tokens are BITWISE the
reference's.  The corpus is a Zipf-ish unigram mixed with a Markov
successor band, so the loss has learnable signal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order_mix: float = 0.7


class SyntheticStream:
    def __init__(self, cfg: DataConfig, model_cfg=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        if model_cfg is not None and model_cfg.arch_type in ("vlm", "audio"):
            raise NotImplementedError(
                f"{model_cfg.arch_type} inputs are not ported yet (ROADMAP "
                f"Queue 1 item 14b)")
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.a = int(rng.integers(3, 97)) * 2 + 1
        self.b = int(rng.integers(0, v))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """The global batch of ``step`` as host int32 arrays."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, step])
        B, T, v = cfg.global_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((B, T), np.int64)
        toks[:, 0] = rng.choice(v, size=B, p=self.unigram)
        mix = rng.random((B, T)) < cfg.order_mix
        iid = rng.choice(v, size=(B, T), p=self.unigram)
        for t in range(1, T):
            succ = (self.a * toks[:, t - 1] + self.b) % v
            toks[:, t] = np.where(mix[:, t], succ, iid[:, t])
        return {"tokens": toks.astype(np.int32)}

    def shard(self, batch, runtime) -> dict[str, torch.Tensor]:
        """This rank's slice of dim 0 of a host batch, on the runtime's
        device (the whole batch on every rank when the batch does not
        divide over the ranks, as the reference's ``batch_pspec``)."""
        out = {}
        for k, a in batch.items():
            lo, hi = runtime.batch_slice(a.shape[0])
            out[k] = torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(
                device=runtime.device, dtype=torch.long)
        return out
