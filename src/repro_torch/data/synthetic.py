"""Synthetic deterministic LM data (cf. ``repro.data.synthetic``).

Tokens follow a fixed random bigram automaton (the numpy table is the JAX
package's, from the same seed), so next-token entropy is far below uniform
and the loss visibly decreases.  The walk's random start tokens and branch
choices come from a ``torch.Generator``: they differ from the JAX
package's draws, so parity tests hand both sides the same batch, or the
same draws to :func:`lm_walk`.

Non-IID data (the campaign simulator's, ``repro_torch.sim``): each worker
gets a Dirichlet(α) mixture over ``n_domains`` automata
(:func:`dirichlet_mixture`), and each of its rows walks the automaton of
a domain drawn from that mixture (:func:`make_noniid_lm_batch`).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

Tensor = torch.Tensor


def _bigram_table(vocab: int, seed: int, branching: int = 4) -> np.ndarray:
    """Each token can be followed by ``branching`` successors (uniformly)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branching), dtype=np.int32)


def lm_walk(tables: Tensor, domains: Tensor, start: Tensor, choices: Tensor
            ) -> Dict[str, Tensor]:
    """The walk of ``rows`` sequences, each through its domain's automaton.

    ``tables`` (K, vocab, branching) successor tables, ``domains`` (rows,)
    each row's table, ``start`` (rows,) first tokens, ``choices`` (rows,
    seq) branch indices; returns int64 ``tokens`` and ``labels`` (rows,
    seq), the labels the tokens shifted by one.
    """
    tables, domains = tables.long(), domains.long()
    rows, seq = choices.shape
    toks = torch.empty((rows, seq + 1), dtype=torch.long)
    toks[:, 0] = start
    for t in range(seq):
        toks[:, t + 1] = tables[domains, toks[:, t], choices[:, t].long()]
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def make_lm_batch(gen: torch.Generator, vocab: int, batch: int, seq: int,
                  seed: int = 1234) -> Dict[str, Tensor]:
    """One (tokens, labels) batch from the bigram automaton, int64 on the
    CPU."""
    table = torch.from_numpy(_bigram_table(vocab, seed)).long()
    start = torch.randint(0, vocab, (batch,), generator=gen)
    choices = torch.randint(0, table.shape[1], (batch, seq), generator=gen)
    return lm_walk(table[None], torch.zeros(batch, dtype=torch.long), start,
                   choices)


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0
               ) -> Iterator[Dict[str, Tensor]]:
    gen = torch.Generator()
    gen.manual_seed(seed)
    while True:
        yield make_lm_batch(gen, vocab, batch, seq, seed=seed + 77)


# --------------------------------------------------------------- non-IID
def dirichlet_mixture(gen: torch.Generator, n_workers: int, n_domains: int,
                      alpha: float) -> Tensor:
    """Per-worker Dirichlet(α) mixture over data domains -> (n_workers, K)
    fp32 on the CPU.

    Small α concentrates each worker on few domains (strong
    heterogeneity, the regime where coordinate-wise rules degrade — Yin et
    al. 2018); α → ∞ recovers i.i.d. workers.  Rows sum to 1.  The draws
    are normalised float64 Gamma(α) draws from ``gen``; they are not the
    JAX package's.  The smallest α the repo passes is 0.1, where a float64
    draw underflows to 0 with probability about 1e-31.
    """
    if n_domains < 1:
        raise ValueError(f"n_domains must be >= 1, got {n_domains}")
    if alpha <= 0:
        raise ValueError(f"alpha must be positive, got {alpha}")
    g = torch._standard_gamma(
        torch.full((n_workers, n_domains), float(alpha), dtype=torch.float64),
        generator=gen)
    return (g / g.sum(dim=-1, keepdim=True)).float()


def make_noniid_lm_batch(gen: torch.Generator, vocab: int, n_workers: int,
                         per_worker: int, seq: int, mixture: Tensor,
                         seed: int = 1234) -> Dict[str, Tensor]:
    """Worker-heterogeneous LM batch: ``(n_workers*per_worker, S)`` tokens.

    Domain k is its own bigram automaton (table seeded ``seed + k``); each
    of worker w's rows draws a domain from ``mixture[w]`` (the Gumbel-max
    of its log-mixture, as JAX's ``categorical``) and walks that domain's
    automaton (:func:`lm_walk`).  Row-major worker order, so
    ``split_workers`` with the same ``n_workers`` recovers the per-worker
    batches.  Deterministic in ``(gen``'s state, ``mixture``, ``seed)``.
    """
    mixture = torch.as_tensor(mixture, dtype=torch.float32).cpu()
    n_domains = mixture.shape[1]
    if mixture.shape[0] != n_workers:
        raise ValueError(
            f"mixture rows ({mixture.shape[0]}) != n_workers ({n_workers})")
    tables = torch.from_numpy(np.stack(
        [_bigram_table(vocab, seed + k) for k in range(n_domains)])).long()
    rows = n_workers * per_worker
    row_logits = torch.repeat_interleave(torch.log(mixture + 1e-20),
                                         per_worker, dim=0)
    u = torch.rand((rows, n_domains), generator=gen)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    domains = torch.argmax(row_logits + gumbel, dim=-1)
    start = torch.randint(0, vocab, (rows,), generator=gen)
    choices = torch.randint(0, tables.shape[2], (rows, seq), generator=gen)
    return lm_walk(tables, domains, start, choices)
