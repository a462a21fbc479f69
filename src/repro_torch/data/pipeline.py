"""Deterministic synthetic token pipeline with shard-aware iteration (the
reference's, in numpy, batch for batch).

Every batch is a pure function of (seed, step, host shard), so a restart
from a checkpoint reproduces the exact token stream (the loader has no
state to checkpoint beyond the step), each data-parallel host pulls only
its shard, and a different host count re-indexes the same global stream.
The rows follow a Zipf-like distribution with induced bigram structure,
packed to a fixed ``seq_len`` with an EOD token.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EOD = 0


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 512


class SyntheticLMStream:
    """Infinite deterministic stream of packed LM batches."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0, "batch must divide hosts"
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # Zipf over the vocab (excluding EOD), fixed per seed.
        ranks = np.arange(1, cfg.vocab_size, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()

    def _row_rng(self, step: int, global_row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, global_row]))

    def _sample_row(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        out = np.empty(c.seq_len + 1, dtype=np.int32)
        i = 0
        while i < len(out):
            doc_len = min(int(rng.geometric(1.0 / c.mean_doc_len)) + 8,
                          len(out) - i)
            toks = rng.choice(len(self._probs), size=doc_len, p=self._probs) + 1
            # induce bigram structure: every odd position correlates w/ prev
            toks[1::2] = (toks[0::2][: len(toks[1::2])] * 7 + 3) % (c.vocab_size - 1) + 1
            out[i:i + doc_len] = toks
            i += doc_len
            if i < len(out):
                out[i] = EOD
                i += 1
        return out

    def batch(self, step: int) -> dict:
        """Host-local batch for ``step``: tokens/labels/loss_mask
        [local_batch, seq_len]."""
        c = self.cfg
        rows = []
        for b in range(self.local_batch):
            global_row = self.host_id * self.local_batch + b
            rows.append(self._sample_row(self._row_rng(step, global_row)))
        arr = np.stack(rows)  # [B, S+1]
        return {
            "tokens": arr[:, :-1],
            "labels": arr[:, 1:].astype(np.int32),
            "loss_mask": (arr[:, 1:] != EOD).astype(np.float32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
