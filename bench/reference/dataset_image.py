"""The synthetic federated image data (a configuration's ``data`` entry
with ``kind`` "image"), worked out again in numpy: class prototypes plus
Gaussian noise, a Dirichlet label-skew partition over the silos and 512
held-out test samples. A frozen copy of the float and random operations
`run_fl` runs, so both sides train on the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TEST_SAMPLES = 512


@dataclasses.dataclass
class Dataset:
    silo_x: list
    silo_y: list
    test_x: np.ndarray
    test_y: np.ndarray


def _dirichlet_partition(labels, num_silos: int, alpha: float, rng):
    num_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    silo_idx = [[] for _ in range(num_silos)]
    for idxs in idx_by_class:
        rng.shuffle(idxs)
        props = rng.dirichlet(np.full(num_silos, alpha))
        cuts = (np.cumsum(props) * len(idxs)).astype(int)[:-1]
        for s, part in enumerate(np.split(idxs, cuts)):
            silo_idx[s].extend(part.tolist())
    out = []
    for s in range(num_silos):
        ii = np.array(sorted(silo_idx[s]), dtype=np.int64)
        if len(ii) < 2:
            ii = rng.integers(0, len(labels), size=8)
        out.append(ii)
    return out


def make_dataset(data_cfg: dict, num_silos: int, samples_per_silo: int,
                 alpha: float, seed: int) -> Dataset:
    """``data_cfg``: the configuration's ``data`` entry (classes, input
    shape, noise, seed offset)."""
    shape = tuple(data_cfg["input_shape"])
    num_classes = data_cfg["classes"]
    rng = np.random.default_rng(seed + data_cfg["seed_offset"])
    protos = rng.normal(size=(num_classes,) + shape).astype(np.float32)
    protos /= np.linalg.norm(protos.reshape(num_classes, -1),
                             axis=1).reshape((-1,) + (1,) * len(shape))
    protos *= np.sqrt(np.prod(shape))
    total = num_silos * samples_per_silo + TEST_SAMPLES
    labels = rng.integers(0, num_classes, size=total)
    x = (protos[labels] + data_cfg["noise"]
         * rng.normal(size=(total,) + shape)).astype(np.float32)
    parts = _dirichlet_partition(labels[:-TEST_SAMPLES], num_silos, alpha,
                                 rng)
    return Dataset(silo_x=[x[p] for p in parts],
                   silo_y=[labels[p].astype(np.int64) for p in parts],
                   test_x=x[-TEST_SAMPLES:],
                   test_y=labels[-TEST_SAMPLES:].astype(np.int64))
