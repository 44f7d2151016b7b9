"""Batch samplers as deterministic numpy index generators.

The port's copy of ``ovmr_tpu/data/samplers.py``: the same index streams
per seed as the JAX package.

Counterparts of the reference samplers (``dassl/data/samplers.py``). Exact
cross-framework RNG parity is impossible; these are seed-stable within this
framework and distributionally equivalent (verified by tests):

- RandomClassSampler: batches of ``ncls_per_batch x n_ins`` indices grouped
  by class; classes with fewer than n_ins items resample with replacement;
  no class dropped (tail batches may hold fewer classes).
- RandomFullClassSampler: N classes per batch with ALL their items.
- RandomDomainSampler / SeqDomainSampler: N domains x K images per batch
  (reference ``samplers.py:12-114``; unused by OVMR configs but part of the
  build_sampler surface).
- Sequential/Random samplers for plain iteration.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


class SequentialSampler:
    def __init__(self, data_source, **kwargs):
        self.n = len(data_source)

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        return np.arange(self.n)


class RandomSampler:
    def __init__(self, data_source, **kwargs):
        self.n = len(data_source)

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        return rng.permutation(self.n)


class RandomClassSampler:
    """N classes x K instances per batch (reference ``samplers.py:117-181``)."""

    def __init__(self, data_source, batch_size: int, n_ins: int, **kwargs):
        if batch_size < n_ins:
            raise ValueError(f"batch_size={batch_size} < n_ins={n_ins}")
        self.n_ins = n_ins
        self.ncls_per_batch = batch_size // n_ins
        self.index_by_label: Dict[int, List[int]] = defaultdict(list)
        for idx, item in enumerate(data_source):
            self.index_by_label[item.label].append(idx)
        self.labels = list(self.index_by_label)

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        # chunk each class's (shuffled, resampled-if-short) indices into
        # groups of n_ins
        groups: Dict[int, List[np.ndarray]] = {}
        for label in self.labels:
            idxs = np.asarray(self.index_by_label[label])
            if len(idxs) < self.n_ins:
                idxs = rng.choice(idxs, size=self.n_ins, replace=True)
            idxs = rng.permutation(idxs)
            n_full = len(idxs) // self.n_ins
            groups[label] = [
                idxs[i * self.n_ins : (i + 1) * self.n_ins] for i in range(n_full)
            ]

        available = [l for l in self.labels if groups[l]]
        out: List[np.ndarray] = []
        while available:
            take = min(self.ncls_per_batch, len(available))
            chosen = rng.choice(len(available), size=take, replace=False)
            chosen_labels = [available[i] for i in chosen]
            for label in chosen_labels:
                out.append(groups[label].pop(0))
                if not groups[label]:
                    available.remove(label)
        return np.concatenate(out) if out else np.empty(0, np.int64)


class RandomFullClassSampler:
    """N classes per batch, all their items (reference ``samplers.py:184-246``)."""

    def __init__(self, data_source, batch_size: int, n_ins: int, **kwargs):
        self.n_ins = n_ins
        self.ncls_per_batch = max(batch_size // n_ins, 1)
        self.index_by_label: Dict[int, List[int]] = defaultdict(list)
        for idx, item in enumerate(data_source):
            self.index_by_label[item.label].append(idx)
        self.labels = list(self.index_by_label)
        # reference samplers.py asserts the class count covers one batch
        assert len(self.labels) >= self.ncls_per_batch, (
            f"{len(self.labels)} classes < {self.ncls_per_batch} per batch"
        )

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        per_label = {}
        for label in self.labels:
            idxs = np.asarray(self.index_by_label[label])
            if len(idxs) < self.n_ins:
                idxs = rng.choice(idxs, size=self.n_ins, replace=True)
            per_label[label] = rng.permutation(idxs)
        order = rng.permutation(len(self.labels))
        out = [per_label[self.labels[i]] for i in order]
        return np.concatenate(out) if out else np.empty(0, np.int64)


class RandomDomainSampler:
    """N random domains x K images per batch (reference ``samplers.py:12-61``).

    Each epoch draws ``n_domain`` domains uniformly, takes ``batch_size //
    n_domain`` images (without replacement within the epoch) from each, and
    stops as soon as any touched domain can no longer fill a full group —
    matching the reference's stop condition."""

    def __init__(self, data_source, batch_size: int, n_domain: int = 0, **kwargs):
        self.index_by_domain: Dict[int, List[int]] = defaultdict(list)
        for idx, item in enumerate(data_source):
            self.index_by_domain[item.domain].append(idx)
        self.domains = sorted(self.index_by_domain)
        if n_domain is None or n_domain <= 0:
            n_domain = len(self.domains)
        if batch_size % n_domain != 0:
            raise ValueError(
                f"batch_size={batch_size} not divisible by n_domain={n_domain}"
            )
        self.n_domain = n_domain
        self.n_img_per_domain = batch_size // n_domain

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        remaining = {
            d: list(rng.permutation(idxs))
            for d, idxs in self.index_by_domain.items()
        }
        out: List[int] = []
        while True:
            chosen = rng.choice(len(self.domains), size=self.n_domain, replace=False)
            stop = False
            for di in chosen:
                pool = remaining[self.domains[di]]
                if len(pool) < self.n_img_per_domain:
                    # only reachable when a domain STARTS with fewer than
                    # n_img_per_domain images — the reference's
                    # random.sample raises there too; a silent short group
                    # would corrupt the [n_domain, K] batch structure
                    raise ValueError(
                        f"domain {self.domains[di]} has {len(pool)} images, "
                        f"needs {self.n_img_per_domain} per batch"
                    )
                out.extend(pool[: self.n_img_per_domain])
                del pool[: self.n_img_per_domain]
                if len(pool) < self.n_img_per_domain:
                    stop = True
            if stop:
                return np.asarray(out, np.int64)


class SeqDomainSampler:
    """Every (sorted) domain contributes K images per batch
    (reference ``samplers.py:64-114``)."""

    def __init__(self, data_source, batch_size: int, **kwargs):
        self.index_by_domain: Dict[int, List[int]] = defaultdict(list)
        for idx, item in enumerate(data_source):
            self.index_by_domain[item.domain].append(idx)
        self.domains = sorted(self.index_by_domain)
        n_domain = len(self.domains)
        if batch_size % n_domain != 0:
            raise ValueError(
                f"batch_size={batch_size} not divisible by n_domain={n_domain}"
            )
        self.n_domain = n_domain
        self.n_img_per_domain = batch_size // n_domain

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        remaining = {
            d: list(rng.permutation(idxs))
            for d, idxs in self.index_by_domain.items()
        }
        out: List[int] = []
        while True:
            stop = False
            for d in self.domains:
                pool = remaining[d]
                out.extend(pool[: self.n_img_per_domain])
                del pool[: self.n_img_per_domain]
                if len(pool) < self.n_img_per_domain:
                    stop = True
            if stop:
                return np.asarray(out, np.int64)


SAMPLERS = {
    "SequentialSampler": SequentialSampler,
    "RandomSampler": RandomSampler,
    "RandomClassSampler": RandomClassSampler,
    "RandomFullClassSampler": RandomFullClassSampler,
    "RandomDomainSampler": RandomDomainSampler,
    "SeqDomainSampler": SeqDomainSampler,
}


def build_sampler(
    name: str, data_source, batch_size: int, n_ins: int = 16, n_domain: int = 0
):
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; available {sorted(SAMPLERS)}")
    return SAMPLERS[name](
        data_source, batch_size=batch_size, n_ins=n_ins, n_domain=n_domain
    )
