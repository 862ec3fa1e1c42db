"""Synthetic stand-ins for the paper's datasets (port of ``repro.data.synthetic``).

The same seeded numpy generator as the JAX package — Gaussian class
mixtures with the Statlog / EuroSAT cardinalities, a PCA-like projection
to the VQC's feature dim, features scaled to [0, π] — so the port's data
is bit-equal to the reference's. Features are float32 and labels int64
(the index dtype torch's gathers take).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_samples: int
    n_raw_features: int
    n_classes: int


STATLOG = DatasetSpec("statlog", 6435, 36, 7)
EUROSAT = DatasetSpec("eurosat", 27000, 64, 10)


def _class_mixture(spec: DatasetSpec, n_features: int, seed: int, device):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.6, (spec.n_classes, spec.n_raw_features))
    mix = rng.normal(0, 1.0, (spec.n_raw_features, spec.n_raw_features))
    labels = rng.integers(0, spec.n_classes, spec.n_samples)
    x = means[labels] + rng.normal(0, 1.0, (spec.n_samples,
                                            spec.n_raw_features)) @ mix * 0.45
    q, _ = np.linalg.qr(rng.normal(0, 1, (spec.n_raw_features,
                                          spec.n_raw_features)))
    z = x @ q[:, :n_features]
    lo, hi = z.min(axis=0), z.max(axis=0)
    z = (z - lo) / np.maximum(hi - lo, 1e-9) * np.pi
    dev = resolve_device(device)
    return (torch.as_tensor(z.astype(np.float32), device=dev),
            torch.as_tensor(labels.astype(np.int64), device=dev))


def make_statlog(n_features: int = 8, seed: int = 0, device=None):
    """(features (6435, n_features) in [0, π], labels (6435,) in [0, 7))."""
    return _class_mixture(STATLOG, n_features, seed, device)


def make_eurosat(n_features: int = 8, seed: int = 1,
                 n_samples: int | None = None, device=None):
    spec = EUROSAT if n_samples is None else DatasetSpec(
        "eurosat", n_samples, EUROSAT.n_raw_features, EUROSAT.n_classes)
    return _class_mixture(spec, n_features, seed, device)
