"""Synthetic federated datasets: a whole copy of `repro.data.synthetic`.

Pure numpy, so the two packages draw identical arrays and an identical
`sample_batch` stream from the same seeds.

Statistical structure matches the paper's setups:
  * label-skewed non-IID partitions (each silo sees a Dirichlet-weighted
    subset of classes — the standard cross-silo heterogeneity model);
  * learnable structure (class prototypes + noise) so FL accuracy
    dynamics are meaningful: local overfitting vs consensus, exactly the
    trade-off Tables 4/6 probe;
  * the three modalities of Table 2: image (FEMNIST/iNat stand-ins) and
    token sequences (Sent140 stand-in), plus an LM stream for the
    LLM-scale examples.

Everything is generated deterministically from seeds; batches are numpy
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FederatedDataset:
    name: str
    silo_x: list[np.ndarray]   # per-silo inputs
    silo_y: list[np.ndarray]   # per-silo labels
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int

    @property
    def num_silos(self) -> int:
        return len(self.silo_x)

    def batch_iter(self, silo: int, batch_size: int, seed: int = 0):
        """Infinite shuffled batch iterator for one silo."""
        x, y = self.silo_x[silo], self.silo_y[silo]
        rng = np.random.default_rng(seed * 1000 + silo)
        n = len(x)
        while True:
            idx = rng.permutation(n)
            for s in range(0, n - batch_size + 1, batch_size):
                sel = idx[s:s + batch_size]
                yield {"x": x[sel], "y": y[sel]}

    def sample_batch(self, silo: int, batch_size: int, rng: np.random.Generator):
        x, y = self.silo_x[silo], self.silo_y[silo]
        sel = rng.integers(0, len(x), size=batch_size)
        return {"x": x[sel], "y": y[sel]}


def _dirichlet_partition(labels: np.ndarray, num_silos: int, alpha: float,
                         rng: np.random.Generator) -> list[np.ndarray]:
    """Standard Dirichlet label-skew partition."""
    num_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    silo_idx: list[list[int]] = [[] for _ in range(num_silos)]
    for c, idxs in enumerate(idx_by_class):
        rng.shuffle(idxs)
        props = rng.dirichlet(np.full(num_silos, alpha))
        cuts = (np.cumsum(props) * len(idxs)).astype(int)[:-1]
        for s, part in enumerate(np.split(idxs, cuts)):
            silo_idx[s].extend(part.tolist())
    out = []
    for s in range(num_silos):
        ii = np.array(sorted(silo_idx[s]), dtype=np.int64)
        if len(ii) < 2:  # guarantee a non-empty silo
            ii = rng.integers(0, len(labels), size=8)
        out.append(ii)
    return out


def _image_classification(name: str, num_silos: int, num_classes: int,
                          shape: tuple[int, ...], samples_per_silo: int,
                          noise: float, alpha: float, seed: int
                          ) -> FederatedDataset:
    """Class prototypes + gaussian noise; linearly separable-ish."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(num_classes,) + shape).astype(np.float32)
    protos /= np.linalg.norm(protos.reshape(num_classes, -1),
                             axis=1).reshape((-1,) + (1,) * len(shape))
    protos *= np.sqrt(np.prod(shape))  # unit-ish per-pixel scale

    total = num_silos * samples_per_silo + 512
    labels = rng.integers(0, num_classes, size=total)
    x = (protos[labels] +
         noise * rng.normal(size=(total,) + shape)).astype(np.float32)
    parts = _dirichlet_partition(labels[:-512], num_silos, alpha, rng)
    return FederatedDataset(
        name=name,
        silo_x=[x[p] for p in parts],
        silo_y=[labels[p].astype(np.int32) for p in parts],
        test_x=x[-512:], test_y=labels[-512:].astype(np.int32),
        num_classes=num_classes)


def _token_classification(name: str, num_silos: int, vocab: int, seq: int,
                          samples_per_silo: int, alpha: float,
                          seed: int) -> FederatedDataset:
    """Two-class token sequences: class-conditional unigram mixtures."""
    rng = np.random.default_rng(seed)
    num_classes = 2
    # Each class prefers a different sub-vocabulary.
    class_logits = rng.normal(size=(num_classes, vocab)) * 2.0
    probs = np.exp(class_logits)
    probs /= probs.sum(axis=1, keepdims=True)

    total = num_silos * samples_per_silo + 512
    labels = rng.integers(0, num_classes, size=total)
    x = np.stack([rng.choice(vocab, size=seq, p=probs[c]) for c in labels])
    x = x.astype(np.int32)
    parts = _dirichlet_partition(labels[:-512], num_silos, alpha, rng)
    return FederatedDataset(
        name=name,
        silo_x=[x[p] for p in parts],
        silo_y=[labels[p].astype(np.int32) for p in parts],
        test_x=x[-512:], test_y=labels[-512:].astype(np.int32),
        num_classes=num_classes)


def make_federated_dataset(kind: str, num_silos: int, *,
                           samples_per_silo: int = 256,
                           alpha: float = 0.5, seed: int = 0
                           ) -> FederatedDataset:
    """kind: femnist | sent140 | inat (the paper's three datasets)."""
    if kind == "femnist":
        return _image_classification("femnist", num_silos, 62, (28, 28, 1),
                                     samples_per_silo, noise=0.6,
                                     alpha=alpha, seed=seed + 1)
    if kind == "inat":
        return _image_classification("inat", num_silos, 64, (32, 32, 3),
                                     samples_per_silo, noise=0.8,
                                     alpha=alpha, seed=seed + 2)
    if kind == "sent140":
        return _token_classification("sent140", num_silos, 15_000, 32,
                                     samples_per_silo, alpha=alpha,
                                     seed=seed + 3)
    raise KeyError(f"unknown dataset kind {kind!r}")


def make_lm_dataset(vocab: int, seq_len: int, num_silos: int, *,
                    samples_per_silo: int = 64, seed: int = 0):
    """Per-silo LM token streams (bigram chains with silo-specific

    transition tweaks -> mild non-IID). Returns list of (samples, seq+1)
    arrays; batches slice [.. :-1] as tokens and [1: ..] as labels."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(vocab, 16)).astype(np.float32)
    out = []
    for s in range(num_silos):
        srng = np.random.default_rng(seed * 7919 + s)
        silo_shift = srng.normal(size=(16,)).astype(np.float32) * 0.5
        # cheap bigram: next-token logits = <emb[cur], emb + shift>
        toks = np.empty((samples_per_silo, seq_len + 1), np.int32)
        cur = srng.integers(0, vocab, size=samples_per_silo)
        toks[:, 0] = cur
        proj = base @ (base + silo_shift).T  # (V, V)
        # top-32 sampling per current token, precomputed
        top = np.argsort(-proj, axis=1)[:, :32]
        for t in range(1, seq_len + 1):
            choice = srng.integers(0, 32, size=samples_per_silo)
            cur = top[cur, choice]
            toks[:, t] = cur
        out.append(toks)
    return out
