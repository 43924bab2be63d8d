"""A copy of ``repro/data/synthetic.py`` (numpy only).

Synthetic-but-learnable LM data: a fixed random first-order Markov chain
over the vocabulary with Zipfian marginals.  Deterministic given seed;
entropy is well below uniform, so models visibly learn (loss drops toward
the chain's conditional entropy) — enough to reproduce the paper's
MoE-beats-dense-at-equal-FLOPs *convergence* comparison qualitatively
without shipping a corpus."""
from __future__ import annotations

import numpy as np


class MarkovLM:
    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 8, skew: float = 1.2):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.branching = branching
        # each state transitions to `branching` successors with Zipf weights
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
        w = 1.0 / np.arange(1, branching + 1) ** skew
        self.w = w / w.sum()

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        state = rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            out[:, t] = state
            choice = rng.choice(self.branching, size=batch, p=self.w)
            state = self.succ[state, choice]
        return out

    def conditional_entropy(self) -> float:
        """Entropy (nats) of the next-token distribution (loss floor)."""
        # ignores successor collisions; close enough for reporting
        return float(-(self.w * np.log(self.w)).sum())


def batches(vocab_size: int, batch: int, seq_len: int, *, seed: int = 0, start_step: int = 0):
    """Infinite deterministic stream of (tokens, labels) numpy batches."""
    lm = MarkovLM(vocab_size, seed)
    step = start_step
    while True:
        rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
        toks = lm.sample(rng, batch, seq_len + 1)
        yield toks[:, :-1], toks[:, 1:]
        step += 1
