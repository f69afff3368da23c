"""Synthetic deterministic LM data (cf. ``repro.data.synthetic``).

Tokens follow a fixed random bigram automaton (the numpy table is the JAX
package's, from the same seed), so next-token entropy is far below uniform
and the loss visibly decreases.  The walk's random start tokens and branch
choices come from a ``torch.Generator``: they differ from the JAX
package's draws, so parity tests hand both sides the same batch.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def _bigram_table(vocab: int, seed: int, branching: int = 4) -> np.ndarray:
    """Each token can be followed by ``branching`` successors (uniformly)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branching), dtype=np.int32)


def make_lm_batch(gen: torch.Generator, vocab: int, batch: int, seq: int,
                  seed: int = 1234) -> Dict[str, torch.Tensor]:
    """One (tokens, labels) batch from the bigram automaton, int64 on the
    CPU."""
    table = torch.from_numpy(_bigram_table(vocab, seed)).long()
    start = torch.randint(0, vocab, (batch,), generator=gen)
    choices = torch.randint(0, table.shape[1], (batch, seq), generator=gen)
    toks = torch.empty((batch, seq + 1), dtype=torch.long)
    toks[:, 0] = start
    for t in range(seq):
        toks[:, t + 1] = table[toks[:, t], choices[:, t]]
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0
               ) -> Iterator[Dict[str, torch.Tensor]]:
    gen = torch.Generator()
    gen.manual_seed(seed)
    while True:
        yield make_lm_batch(gen, vocab, batch, seq, seed=seed + 77)
