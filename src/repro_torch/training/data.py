"""Deterministic synthetic LM data pipeline.

The reference's ``training/data``, copied (it imports numpy only) and
held to it bit for bit.

Offline container: generates a seeded, Zipf-distributed token stream with
document structure (BOS-delimited docs of lognormal length), packed into
fixed (batch, seq) blocks -- enough structure for a ~100M model to show a
real loss curve.  The iterator is stateless-resumable: ``state`` is a plain
int cursor that checkpoints alongside the train state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_batch_iterator"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    bos: int = 1


class SyntheticLM:
    """Markov-flavoured Zipf stream: token t+1 depends on t via a seeded
    permutation mix, so the data has learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)
        # Zipf over an effective vocabulary (clipped to vocab_size)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = p / p.sum()

    def batch_at(self, cursor: int) -> dict:
        """Deterministic batch for a given cursor (resume = same stream)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, cursor))
        shape = (cfg.batch, cfg.seq_len + 1)
        base = rng.choice(cfg.vocab_size, size=shape, p=self.p)
        # bigram structure: with prob .5, next token = perm[prev]
        mix = rng.random(shape) < 0.5
        stream = base.copy()
        stream[:, 1:] = np.where(
            mix[:, 1:], self.perm[stream[:, :-1]], base[:, 1:])
        # document boundaries
        doclen = np.maximum(
            8, rng.poisson(cfg.mean_doc_len, size=(cfg.batch, 4)))
        for b in range(cfg.batch):
            pos = np.cumsum(doclen[b])
            pos = pos[pos < cfg.seq_len]
            stream[b, pos] = cfg.bos
        tokens = stream[:, :-1].astype(np.int32)
        labels = stream[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


def make_batch_iterator(cfg: DataConfig, start_cursor: int = 0):
    """Yields (cursor, batch) pairs; checkpoint the cursor to resume."""
    ds = SyntheticLM(cfg)
    cursor = start_cursor
    while True:
        yield cursor, ds.batch_at(cursor)
        cursor += 1
