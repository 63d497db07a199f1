"""Deterministic synthetic data pipeline (the port's copy of
``repro.data.pipeline``: numpy only, batches byte-equal to the reference's).

Produces host-sharded batches without any I/O dependency: token streams are
generated from a counter-based PRNG (seed, step, shard) so every host
materializes exactly its shard and restarts reproduce the same stream after
checkpoint resume (the pipeline state is just the step counter).

Per family:
  * lm/moe/ssm/hybrid : {"tokens", "labels", "mask"}
  * vlm               : + "enc" stub patch embeddings (B, T_img, d_model)
  * audio             : "tokens" are precomputed frame embeddings
                        (B, S, d_model) and "labels" EnCodec ids — the
                        frontend STUB per the assignment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.common.config import ModelConfig


@dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    pack_documents: bool = True
    mean_doc_len: int = 512
    eos_id: int = 1


class SyntheticDataset:
    """Stateless per-step batch generator (state == step index)."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        assert dc.global_batch % dc.num_hosts == 0
        self.cfg = cfg
        self.dc = dc
        self.local_batch = dc.global_batch // dc.num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step, self.dc.host_index]))

    def _token_batch(self, rng, vocab: int) -> np.ndarray:
        b, s = self.local_batch, self.dc.seq_len
        toks = rng.integers(2, vocab, size=(b, s), dtype=np.int32)
        if self.dc.pack_documents:
            # plant EOS boundaries ~ geometric(1/mean_doc_len): packed docs
            eos = rng.random((b, s)) < 1.0 / self.dc.mean_doc_len
            toks = np.where(eos, self.dc.eos_id, toks)
        return toks

    def batch(self, step: int) -> Dict[str, Any]:
        rng = self._rng(step)
        cfg, dc = self.cfg, self.dc
        b, s = self.local_batch, dc.seq_len
        out: Dict[str, Any] = {}
        if cfg.family == "audio":
            labels = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
            frames = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
            out["tokens"] = frames          # precomputed frame embeddings
            out["labels"] = labels
        else:
            toks = self._token_batch(rng, cfg.vocab_size)
            out["tokens"] = toks
            out["labels"] = toks            # next-token: shift happens in loss
        out["mask"] = np.ones((b, s), np.float32)
        if cfg.family == "vlm":
            out["enc"] = rng.standard_normal(
                (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
