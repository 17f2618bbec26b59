"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and the seed, and yields the cell's work.

Every seed gets the same set of sizes, in another order, so that two seeds
ask for the same work: prefill batches come in blocks, each a permutation
of the mix's sequence lengths.
"""
from __future__ import annotations

import numpy as np

from .harness import seed_ints


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_ints(seed, stream + 1)[stream])


def sequence_lengths(traffic: dict, seed: int):
    """Prefill sequence lengths: blocks, each a permutation of ``seq_lens``."""
    lens = traffic["seq_lens"]
    rng = _rng(seed, 1)
    while True:
        for k in rng.permutation(len(lens)):
            yield int(lens[int(k)])


def sample(seed: int, population: int, k: int, stream: int = 3) -> list[int]:
    """``k`` distinct indices of ``range(population)`` drawn from the seed,
    in the order drawn."""
    rng = _rng(seed, stream)
    return [int(i) for i in rng.choice(population, min(k, population), replace=False)]
