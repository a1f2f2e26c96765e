"""Deterministic, shardable token pipeline.

Two sources behind one interface:
  * SyntheticSource — seeded per (step, shard): reproducible anywhere, the
    default for smoke/dry-run/benchmarks.
  * FileSource — memory-mapped flat token file (one uint32 per token),
    strided into per-shard windows.

Determinism contract (fault tolerance): ``batch(step)`` is a pure function of
(seed, step, shard) — after a restart the pipeline *skips ahead* by resuming
at the checkpointed step; no iterator state needs saving.  Straggler
mitigation can re-issue any step's batch on a different host for the same
result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    path: Optional[str] = None  # None => synthetic
    shard_index: int = 0
    shard_count: int = 1


class SyntheticSource:
    def __init__(self, cfg: DataConfig, vocab: int) -> None:
        self.cfg = cfg
        self.vocab = vocab

    def tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        seed = (self.cfg.seed * 1_000_003 + step) * 65_537 + self.cfg.shard_index
        rng = np.random.default_rng(seed)
        # zipf-ish marginal so CE losses move like real text rather than
        # uniform noise
        z = rng.zipf(1.2, size=(batch, seq)).astype(np.int64)
        return np.minimum(z - 1, self.vocab - 1).astype(np.int32)


class FileSource:
    def __init__(self, cfg: DataConfig, vocab: int) -> None:
        self.cfg = cfg
        self.vocab = vocab
        self._data = np.memmap(cfg.path, dtype=np.uint32, mode="r")

    def tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        n = self._data.shape[0]
        need = batch * (seq + 1)
        start = (step * self.cfg.shard_count + self.cfg.shard_index) * need % max(n - need, 1)
        chunk = np.asarray(self._data[start : start + need]).astype(np.int64)
        return (chunk[: batch * seq].reshape(batch, seq) % self.vocab).astype(np.int32)


class Pipeline:
    """Builds model-ready batches for any of the 10 architectures."""

    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig = DataConfig()) -> None:
        self.mc = model_cfg
        self.dc = data_cfg
        src_cls = FileSource if data_cfg.path else SyntheticSource
        self.source = src_cls(data_cfg, model_cfg.vocab_size)

    def batch(self, step: int, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        mc = self.mc
        out: Dict[str, np.ndarray] = {}
        if mc.frontend == "vision":
            n_txt = seq_len - mc.frontend_tokens
            toks = self.source.tokens(step, batch_size, n_txt)
            rng = np.random.default_rng(self.dc.seed * 7 + step)
            out["patch_embeds"] = rng.normal(size=(batch_size, mc.frontend_tokens, mc.d_model)).astype(np.float32)
            out["tokens"] = toks
            out["labels"] = toks
        else:
            toks = self.source.tokens(step, batch_size, seq_len)
            out["tokens"] = toks
            out["labels"] = toks
        if mc.family == "encdec":
            rng = np.random.default_rng(self.dc.seed * 13 + step)
            out["src_embeds"] = rng.normal(size=(batch_size, seq_len, mc.d_model)).astype(np.float32)
        return out
